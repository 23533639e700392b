"""The PyTorch port stands alone: no JAX, no TPU package, no build at import,
and no quiet fallback to the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "structured_alignment_vqa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "structured_alignment_vqa_tpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(module: str) -> bool:
    # exact package match: structured_alignment_vqa_tpu_torch is allowed
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_match_is_exact():
    assert _forbidden("structured_alignment_vqa_tpu.ops.layers")
    assert _forbidden("structured_alignment_vqa_tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("structured_alignment_vqa_tpu_torch.ops.layers")
    assert not _forbidden("jaxtyping")


def test_port_and_chip_smoke_import_no_jax_and_no_tpu_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imported_modules(f)
           if _forbidden(m)]
    assert not bad, bad


def test_package_imports_without_jax_nvcc_or_triton():
    """Every module imports in a fresh interpreter; none of them pulls in
    JAX or triton, or builds a kernel."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import structured_alignment_vqa_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',"
        " 'triton', 'structured_alignment_vqa_tpu')]\n"
        "assert not bad, bad\n"
        "from structured_alignment_vqa_tpu_torch.ops import _build\n"
        "assert not _build._libs\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from structured_alignment_vqa_tpu_torch.data.synthetic import synthetic_batch
    from structured_alignment_vqa_tpu_torch.models import AttModelX3, tiny_test_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AttModelX3(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batch(cfg, 2)
    assert AttModelX3(cfg, device="cpu") is not None
    assert synthetic_batch(cfg, 2, device="cpu").batch_size == 2


def test_kernel_wrappers_on_cpu_tensors_never_build(monkeypatch):
    from structured_alignment_vqa_tpu_torch.ops import _build
    from structured_alignment_vqa_tpu_torch.ops.fused_ffn import fused_ffn
    from structured_alignment_vqa_tpu_torch.ops.fused_graph_attention import (
        fused_graph_attention_ln,
        fused_graph_attention_ln_bwd,
    )

    def refuse(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    c = 16
    x = torch.randn(2, 5, c, requires_grad=True)
    y = fused_ffn(x, torch.randn(4 * c, c), torch.zeros(4 * c), torch.randn(c, 4 * c),
                  torch.zeros(c), torch.ones(c), torch.zeros(c))
    masks = (torch.ones(2, 5), torch.ones(2, 5), torch.ones(2, 5, 5))
    z = fused_graph_attention_ln(y, y, y, *masks, y, torch.ones(c), torch.zeros(c), 2, "l1")
    z.sum().backward()                      # K2's and K3's backward on CPU tensors
    assert x.grad is not None
    fused_graph_attention_ln_bwd(x.detach(), x.detach(), x.detach(), *masks, x.detach(),
                                 torch.ones(c), torch.zeros(c), torch.ones(2, 5, c), 2, "l1")


def test_flash_wrappers_on_cpu_tensors_never_build(monkeypatch):
    from structured_alignment_vqa_tpu_torch.ops import _build
    from structured_alignment_vqa_tpu_torch.ops import flash_graph_attention as flash

    def refuse(name):
        raise AssertionError(f"built {name} for a CPU tensor")

    monkeypatch.setattr(_build, "library", refuse)
    q = torch.rand(2, 5, 16, requires_grad=True)
    masks = (torch.ones(2, 5), torch.ones(2, 5), torch.ones(2, 5, 5))
    out = flash.flash_graph_attention(q, q, q, *masks, 2, "l1")
    out.sum().backward()                    # K5's and K6's plain versions
    assert q.grad is not None
    assert len(flash.flash_graph_attention(q, q, q, *masks, 2, "sum_eps", emit="partial")) == 4
    assert (flash.flash_graph_attention.launches, flash.flash_bwd_dq.launches,
            flash.flash_bwd_dkv.launches) == (0, 0, 0)


def test_every_cuda_source_is_registered_for_the_build():
    from structured_alignment_vqa_tpu_torch.ops import _build

    on_disk = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert on_disk == sorted(_build.SOURCES)
    assert {"flash_graph_attention", "flash_graph_attention_bwd"} <= set(on_disk)
