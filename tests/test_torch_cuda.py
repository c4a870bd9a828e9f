"""The port's CUDA kernels on the card (cadrays_tpu_torch.kernels).

These tests need an NVIDIA card and nvcc; elsewhere they skip. On the
card run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the
repo's conftest imports JAX, which the card machine lacks).
Each kernel (K1 wide_trace in its variants (a) and (b) instanced, K2
binary_trace, K3 bruteforce) must agree bit for bit with its plain
PyTorch version (built with -fmad=false, same operation order).
"""
import numpy as np
import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_trace_kernel_matches_plain_version(card, any_hit):
    from cadrays_tpu_torch.ops import wide
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    geom = cornell_box(full=True).flatten(cornell_camera(),
                                          device=card).geometry
    rng = np.random.default_rng(0)
    n = 16384
    o = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(card)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d = torch.from_numpy(d).to(card)
    tm = torch.full((n,), 1e30, device=card)
    tm[::11] = 0.0
    before = wide.trace_wide.launches
    got = wide.trace_wide(geom, o, d, tm, any_hit=any_hit)
    assert wide.trace_wide.launches == before + 1
    ref = wide.trace_wide_ref(geom, o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    assert torch.equal(got["tri"] >= 0, ref["tri"] >= 0)
    assert torch.equal(got["t"], ref["t"])
    assert bool((got["tri"][::11] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_trace_kernel_instanced_matches_plain_version(card, any_hit):
    """K1 variant (b) on a 3x3 grid of instanced tori (a shared BLAS,
    rotated instances): bit-equal to trace_wide_ref, hit ids fused."""
    from cadrays_tpu_torch.ops import wide
    from cadrays_tpu_torch.testing.scenes import torus_grid

    geom = torus_grid(3, 24, 12, device=card)[0].geometry
    assert geom.instanced and geom.wdelta.shape[0] == 9
    rng = np.random.default_rng(2)
    n = 16384
    o = rng.uniform([-1, -1, -1], [6.2, 6.2, 2], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    tm = torch.full((n,), 1e30, device=card)
    tm[::11] = 0.0
    before = wide.trace_wide.launches
    got = wide.trace_wide(geom, o, d, tm, any_hit=any_hit)
    assert wide.trace_wide.launches == before + 1
    ref = wide.trace_wide_ref(geom, o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    assert bool((ref["tri"] >= geom.wtris_packed.shape[0]).any())
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(got[k], ref[k]), k
    assert bool((got["tri"][::11] == -1).all())


def _cornell_bounce_rays(card, n=16384):
    from cadrays_tpu_torch.testing.scenes import cornell_box, cornell_camera

    geom = cornell_box(full=True).flatten(cornell_camera(),
                                          device=card).geometry
    rng = np.random.default_rng(1)
    o = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(card)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = torch.full((n,), 1e30, device=card)
    tm[::11] = 0.0
    return geom, o, torch.from_numpy(d).to(card), tm


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["binary", "bruteforce"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_k2_k3_kernels_match_plain_versions(card, kernel, any_hit):
    """K2 (kernels/binary_trace.cu) and K3 (kernels/bruteforce.cu) agree
    bit for bit with trace_binary_ref and trace_bruteforce_ref."""
    from cadrays_tpu_torch.ops import binary, bruteforce

    wrapper, plain = {
        "binary": (binary.trace_binary, binary.trace_binary_ref),
        "bruteforce": (bruteforce.trace_bruteforce,
                       bruteforce.trace_bruteforce_ref)}[kernel]
    geom, o, d, tm = _cornell_bounce_rays(card)
    before = wrapper.launches
    got = wrapper(geom, o, d, tm, any_hit=any_hit)
    assert wrapper.launches == before + 1
    ref = plain(geom, o, d, tm, any_hit=any_hit)
    torch.cuda.synchronize()
    assert bool((ref["tri"] >= 0).any())
    for k in ("tri", "t", "u", "v"):
        assert torch.equal(got[k], ref[k]), k
    assert bool((got["tri"][::11] == -1).all())
