"""The port's CUDA kernels on the card (cadrays_tpu_torch.kernels).

These tests need an NVIDIA card and nvcc; elsewhere they skip. On the
card run them with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the
repo's conftest imports JAX, which the card machine lacks).
Each kernel (K1 wide_trace in its variants (a), (b) instanced and (d)
seeded, K2 binary_trace, K3 bruteforce) must agree bit for bit with its
plain PyTorch version (built with -fmad=false, same operation order).
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


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_trace_kernel_seeded_matches_plain_version(card, any_hit):
    """K1 variant (d): every launch of trace_wide_rebinned on five
    distinct instanced meshes (boxes whose BLAS is one leaf, spheres and
    a torus whose BLAS is a wide node) agrees bit for bit with
    trace_wide_ref given the same seeds and block."""
    from cadrays_tpu_torch.core.bsdf import material
    from cadrays_tpu_torch.geometry.primitives import box, sphere, torus
    from cadrays_tpu_torch.ops import wide
    from cadrays_tpu_torch.scene.instances import build_instanced

    meshes = [box(1, 1, 1), sphere(0.6, 12, 8), torus(0.7, 0.25, 12, 8),
              box(0.5, 2.0, 0.5), sphere(0.4, 10, 6)]
    tfs = []
    for i in range(5):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = (i * 0.9, (i % 2) * 0.8, 0.2 * i)
        tfs.append(m)
    geom = build_instanced(meshes, tfs, [material()], [0] * 5,
                           device=card).geometry
    rng = np.random.default_rng(7)
    n = 16384
    o = rng.uniform(-1.0, 5.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o).to(card), torch.from_numpy(d).to(card)
    tm = torch.full((n,), 1e30, device=card)
    launch = wide._launch
    seen = []

    def checked(g, o_, d_, tm_, any_hit_, start=None, block=None):
        got = launch(g, o_, d_, tm_, any_hit_, start=start, block=block)
        ref = wide.trace_wide_ref(g, o_, d_, tm_, any_hit=any_hit_,
                                  start=start, block=block)
        torch.cuda.synchronize()
        assert start is not None and block == 64
        for k in ("tri", "t", "u", "v"):
            assert torch.equal(got[k], ref[k]), k
        seen.append(int((ref["tri"] >= 0).sum()))
        return got

    wide._launch = checked
    try:
        res = wide.trace_wide_rebinned(geom, o, d, tm, any_hit=any_hit,
                                       block=64)
    finally:
        wide._launch = launch
    assert len(seen) > 1 and sum(seen) > 0
    root = wide.trace_wide(geom, o, d, tm, any_hit=any_hit)
    assert torch.equal(res["tri"] >= 0, root["tri"] >= 0)
