"""cadrays_tpu_torch — the PyTorch / CUDA port of the cadrays_tpu renderer.

A second package beside the JAX reference. It renders the persistent
wavefront path tracer on an NVIDIA H100, on baked and on two-level
instanced scenes: plain tensor code is PyTorch, and the traversal
kernels that the reference wrote in Pallas for the TPU are hand-written
CUDA kernels (``kernels/*.cu``; the BVH8 walk ``wide_trace.cu`` is
wrapped by ``ops/wide.trace_wide``). On CPU tensors each wrapper runs
its kernel's plain PyTorch version, which the tests hold against the
reference.

This package imports torch and numpy only: nothing of the JAX stack and
no module of the reference package.
"""
from cadrays_tpu_torch.device import resolve_device, set_fp32_policy

set_fp32_policy()

from cadrays_tpu_torch.core.bsdf import Material, material  # noqa: E402
from cadrays_tpu_torch.core.camera import Camera  # noqa: E402
from cadrays_tpu_torch.core.lights import (Lights, directional_light,  # noqa: E402
                                           positional_light)
from cadrays_tpu_torch.integrator.params import RenderMode, RenderParams  # noqa: E402
from cadrays_tpu_torch.integrator.renderer import Renderer  # noqa: E402
from cadrays_tpu_torch.scene.flatten import SceneData  # noqa: E402
from cadrays_tpu_torch.scene.scene import Scene  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Lights",
    "Material",
    "RenderMode",
    "RenderParams",
    "Renderer",
    "Scene",
    "SceneData",
    "directional_light",
    "material",
    "positional_light",
    "resolve_device",
    "set_fp32_policy",
]
