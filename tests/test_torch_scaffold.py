"""The port's package boundary and device policy (cadrays_tpu_torch).

The port imports torch and numpy only: never jax, flax or any module
of cadrays_tpu (importing any of those runs cadrays_tpu/__init__.py,
which imports JAX). Entry points run on the card unless the caller asks
for the CPU, and without a card they raise rather than carry on.
"""
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cadrays_tpu_torch")


def test_import_pulls_in_no_jax_in_a_fresh_process():
    code = ("import sys, cadrays_tpu_torch, cadrays_tpu_torch.ops.wide, "
            "cadrays_tpu_torch.ops.binary, cadrays_tpu_torch.ops.bruteforce, "
            "cadrays_tpu_torch.ops.traverse, "
            "cadrays_tpu_torch.integrator.renderer, "
            "cadrays_tpu_torch.testing.scenes, "
            "cadrays_tpu_torch.scene.instances, "
            "cadrays_tpu_torch.kernels.build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'cadrays_tpu'))\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cpp")):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("pattern", [r"import\s+jax", r"from\s+jax\b",
                                     r"\bflax\b"])
def test_no_source_mentions_jax_or_flax(pattern):
    hits = [p for p in _sources()
            if re.search(pattern, open(p, encoding="utf-8").read())]
    assert not hits, hits


def test_no_source_names_a_reference_module():
    """No `cadrays_tpu.` anywhere (`cadrays_tpu_torch.` is the port's own
    prefix), so no copied import can reach the JAX package."""
    hits = [(p, m.group(0)) for p in _sources()
            for m in re.finditer(r"\bcadrays_tpu\.\w*",
                                 open(p, encoding="utf-8").read())]
    assert not hits, hits


def test_fp32_policy_is_set():
    import cadrays_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_without_device_raise_without_a_card(monkeypatch):
    from cadrays_tpu_torch.integrator.renderer import Renderer
    from cadrays_tpu_torch.testing.scenes import cornell_box

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Renderer()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cornell_box().flatten()
    Renderer(device="cpu")  # asking for the CPU is allowed
