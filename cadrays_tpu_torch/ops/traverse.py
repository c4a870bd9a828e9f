"""Ray queries against the scene: trace, trace_sorted, occluded, and the
traversal backend switch.

``trace`` dispatches on the backend set by ``set_backend``, as the
reference's ops/traverse.py does, with its names and its order of
fall-through. The fall-through is decided by the geometry, before any
launch:

- ``"bruteforce"``: ``ops/bruteforce.trace_bruteforce`` (kernel K3),
  or ``"wide"`` when ``fits_bruteforce`` fails;
- ``"wide"`` (the default): ``ops/wide.trace_wide`` (kernel K1), or
  ``"pallas"`` when ``fits_wide`` fails;
- ``"pallas"``: ``ops/binary.trace_binary`` (kernel K2), for every
  non-instanced scene (the card has no on-chip size limit to check),
  or ``"stream"`` on an instanced scene;
- ``"gather"``: ``trace_gather``, K2's walk in plain PyTorch, with the
  reference's instanced branch;
- ``"stream"`` (the reference's packet walk) is not ported yet: it
  raises.

So an instanced two-level scene reaches K1 variant (b) under ``"wide"``
and ``"bruteforce"`` (K3 refuses it, as the reference's does), and
raises under ``"pallas"`` (K2 refuses it, and ``"stream"`` is not
ported).

Each kernel wrapper launches its CUDA kernel on a CUDA tensor and runs
its plain PyTorch version on a CPU tensor. A failed build or launch
raises: once a kernel is chosen, nothing gives way to another walker.
"""
from __future__ import annotations

import torch

from cadrays_tpu_torch.ops.binary import trace_binary, trace_binary_ref
from cadrays_tpu_torch.ops.bruteforce import fits_bruteforce, trace_bruteforce
from cadrays_tpu_torch.ops.wide import fits_wide, trace_wide

_BACKENDS = ("bruteforce", "wide", "pallas", "stream", "gather")
_BACKEND = "wide"


def get_backend() -> str:
    return _BACKEND


def set_backend(name: str) -> None:
    """Select the traversal implementation: 'bruteforce' (K3, scenes of
    up to MAX_TRIS triangle rows), 'wide' (K1, BVH8), 'pallas' (K2,
    binary tree), 'gather' (plain PyTorch per-ray walk) or 'stream' (not
    ported: raises when traced)."""
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"unknown traversal backend {name!r}; "
                         f"expected one of {_BACKENDS}")
    _BACKEND = name


def trace(geom, origin, direction, t_max, any_hit: bool = False):
    """Trace (R, 3) rays up to t_max (R,) with the selected backend.

    Returns dict: t (R,), tri (R,) int32 (-1 miss), u, v (R,). With
    any_hit, ``tri >= 0`` means occluded.
    """
    backend = _BACKEND
    if backend == "bruteforce":
        if fits_bruteforce(geom):
            return trace_bruteforce(geom, origin, direction, t_max,
                                    any_hit=any_hit)
        backend = "wide"
    if backend == "wide":
        # also the reference's fits_wide_hbm branch: K1 reads any table size
        if fits_wide(geom):
            return trace_wide(geom, origin, direction, t_max,
                              any_hit=any_hit)
        backend = "pallas"
    if backend == "pallas":
        if not geom.instanced:
            return trace_binary(geom, origin, direction, t_max,
                                any_hit=any_hit)
        backend = "stream"
    if backend == "stream":
        raise NotImplementedError(
            "the packet (stream) traversal is not ported yet: ROADMAP "
            "queue A, item 12")
    return trace_gather(geom, origin, direction, t_max, any_hit=any_hit)


def trace_sorted(geom, origin, direction, t_max, any_hit: bool = False):
    """`trace` with rays reordered by (direction octant, origin Morton
    cell) for coherence; results come back in the caller's order.

    The brute-force backend does not depend on coherence, so it traces
    in the caller's order."""
    if _BACKEND == "bruteforce" and fits_bruteforce(geom):
        return trace(geom, origin, direction, t_max, any_hit=any_hit)
    key = _coherence_key(geom, origin, direction)
    perm = torch.argsort(key, stable=True)
    tm = torch.as_tensor(t_max, dtype=torch.float32,
                         device=origin.device).expand(origin.shape[0])
    res = trace(geom, origin[perm], direction[perm], tm[perm].contiguous(),
                any_hit=any_hit)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return {k: v[inv] for k, v in res.items()}


def occluded(geom, origin, direction, t_max):
    """Boolean shadow query along (origin, direction) up to t_max."""
    return trace(geom, origin, direction, t_max, any_hit=True)["tri"] >= 0


def _coherence_key(geom, origin, direction):
    """Sort key: 3-bit direction octant | 12-bit origin Morton cell, in
    the box of node 0 (the TLAS root on an instanced scene)."""
    root_lo = geom.nodes_packed[0, 0:3]
    root_hi = geom.nodes_packed[0, 3:6]
    extent = torch.clamp(root_hi - root_lo, min=1e-6)
    q = torch.clamp((origin - root_lo) / extent, 0.0, 0.999)
    cell = (q * 16.0).to(torch.int64)  # 4 bits per axis
    morton = (_interleave4(cell[:, 0]) | (_interleave4(cell[:, 1]) << 1)
              | (_interleave4(cell[:, 2]) << 2))
    octant = ((direction[:, 0] >= 0).long()
              | ((direction[:, 1] >= 0).long() << 1)
              | ((direction[:, 2] >= 0).long() << 2))
    return (octant << 12) | morton


def _interleave4(x):
    """Spread 4 bits of x to every 3rd bit (Morton component)."""
    x = x & 0xF
    x = (x | (x << 4)) & 0x0C3
    x = (x | (x << 2)) & 0x249
    return x


def trace_gather(geom, origin, direction, t_max, any_hit: bool = False):
    """Per-ray walk of the binary threaded tree in plain PyTorch, on any
    device (the reference's ``"gather"`` backend, traverse.py:199-278).
    It is the walk that K2 runs, so it is K2's plain version; on an
    instanced scene it walks the fused two-level tree, moving each ray
    into the space of the node it visits (traverse.py:233-240)."""
    return trace_binary_ref(geom, origin, direction, t_max, any_hit=any_hit)
