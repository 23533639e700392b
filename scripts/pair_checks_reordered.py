"""chip_smoke.py's f32 pair checks with K3's float32 sums in another order.

In float32 at C up to 512, K3's products path sums each output over the
whole hidden width in one FMA chain (``ops/fused_ffn.py:f32_shard_chunks``):
its first kernel's bits, which the f32 pair checks were first tuned on.
This control forces that plan to two hidden shards, summed by the shard-sum
kernel, and runs every phase of ``chip_smoke.py`` that holds such a check
(serving, objrel_serving, packed, dp, variants, seq, model). Each check's
reference takes the tested path's decisions (``chip_smoke.py:Pins``), so a
check that passes here does not hang on K3's last bits.

The plan is changed only in this script's processes, the phases' spawned
ranks included: a ``sitecustomize`` module written to a temporary
directory on ``PYTHONPATH`` patches ``f32_shard_chunks`` as the module is
first imported (and then runs any other ``sitecustomize`` on the path).
The package and ``chip_smoke.py`` have no switch for it.

    python3 scripts/pair_checks_reordered.py    # needs an H100 and nvcc (~8 min)

Prints the card, the forced plan at the main path's f32 shapes, each check's
largest error beside its limit, the decisions its reference runs took
against their own (the largest |input| and its share of its call's
largest), and the checks that failed, last the table of checks (also in
``chiprun_out/pair_checks_reordered_summary.txt``); the whole output of
chip_smoke.py goes to ``chiprun_out/pair_checks_reordered.txt``. Exits
with chip_smoke.py's code.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = "serving,objrel_serving,packed,dp,variants,seq,model"
SHARDS = 2
MARK = "pair check: "

SITECUSTOMIZE = '''\
"""Force K3's float32 plan at C <= 512 to {shards} hidden shards (written by
scripts/pair_checks_reordered.py for its processes)."""
import importlib.abc
import importlib.util
import importlib.machinery
import os
import sys

TARGET = "structured_alignment_vqa_tpu_torch.ops.fused_ffn"


def _patch(module):
    whole = module.f32_shard_chunks

    def f32_shard_chunks(c, hidden):
        if c not in module.WIDTHS:
            return whole(c, hidden)
        return -(-(hidden // module.HIDDEN_CHUNK) // {shards})

    module.f32_shard_chunks = f32_shard_chunks


class _Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name != TARGET:
            return None
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        if spec is None:
            return None
        run = spec.loader.exec_module

        def exec_module(module):
            run(module)
            _patch(module)

        spec.loader.exec_module = exec_module
        return spec


sys.meta_path.insert(0, _Finder())
# the next sitecustomize on the path, if any, as Python would have run it
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''

PLAN_PROBE = '''\
import torch
from structured_alignment_vqa_tpu_torch.ops import fused_ffn as f
for rows, c, hidden in ((16384, 512, 2048), (6144, 512, 2048), (16384, 512, 1024),
                        (16384, 512, 128), (3136, 2048, 8192)):
    print(rows, c, hidden, f.kernel_ffn_split(torch.float32, rows, c, hidden))
'''


def main() -> int:
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        Path(tmp, "sitecustomize.py").write_text(SITECUSTOMIZE.format(shards=SHARDS))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (tmp, str(ROOT), env.get("PYTHONPATH", "")) if p)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(f"card: {card}", flush=True)
        probe = subprocess.run([sys.executable, "-c", PLAN_PROBE], env=env, cwd=ROOT,
                               capture_output=True, text=True, check=True).stdout
        print("K3 f32 (n_split, chunks a shard) by (rows, C, hidden) with the forced plan:")
        print(probe, end="", flush=True)
        if "(2, 16)" not in probe.splitlines()[0]:
            print("pair_checks_reordered: the forced plan did not take", file=sys.stderr)
            return 2
        with open(out_dir / "pair_checks_reordered.txt", "w") as log:
            proc = subprocess.Popen([sys.executable, "chip_smoke.py", "--phases", PHASES],
                                    env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            lines = []
            for line in proc.stdout:
                log.write(line)
                lines.append(line.rstrip("\n"))
            rc = proc.wait()
    checks = [json.loads(line[len(MARK):]) for line in lines if line.startswith(MARK)]
    summary = [line for line in lines if "decision(s) pinned" in line or "do not match" in line]
    failed = [line for line in lines if line.startswith("FAIL ")]
    summary.append(f"{len(checks)} pair checks; chip_smoke.py exited {rc}; {len(failed)} "
                   f"check(s) failed{':' if failed else ''}")
    summary += ["  " + line for line in failed]
    summary.append(f"{'check':<34} {'err':>10} {'limit':>10} {'pinned':>7} {'decisions':>11} "
                   f"{'cm rows':>7} {'largest |x|':>11} {'share':>9}  gate  pass")
    for c in checks:
        summary.append(
            f"{c['check']:<34} {c['err']:>10.3g} {c['limit']:>10.3g} {c['pinned']:>7d} "
            f"{c['decisions']:>11d} {c['content_mask_pinned']:>7d} {c['largest_x']:>11.3g} "
            f"{c['largest_share']:>9.3g}  {str(c['gate']):<5} {c['err'] <= c['limit']}"
            + (f"  ({c['what']})" if c["what"] else ""))
    summary.append(f"card: {card}")
    (out_dir / "pair_checks_reordered_summary.txt").write_text("\n".join(summary) + "\n")
    print("\n".join(summary), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
