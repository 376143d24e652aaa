"""open_diffusiongs_tpu_torch — the PyTorch + CUDA port of open_diffusiongs_tpu
for one NVIDIA Hopper GPU (H100).

The JAX package beside it is the reference: every module here sits at the
same relative path as its JAX counterpart and is held against it by the
`tests/test_torch_*.py` parity tests.  Plain tensor code is PyTorch; the two
Pallas kernels of the object-sampling path are hand-written CUDA C++ for
sm_90a (`csrc/`), built with nvcc at first use (`ops/_build.py`).

This package imports `torch` and never `jax`, `flax`, `optax` or `orbax`.

Registry semantics mirror open_diffusiongs_tpu/__init__.py (string names
registered via @register, dotted-path dynamic import in `find`).
"""

import torch

__version__ = "0.1.0"

__modules__ = {}

# f32 matmuls and convolutions on CUDA run in full f32 (no TF32): the
# geometry and the f32 parity paths need all 24 mantissa bits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def register(name: str):
    """Class decorator registering `cls` under `name`."""

    def decorator(cls):
        if name in __modules__ and __modules__[name] is not cls:
            raise ValueError(
                f"Module {name} already registered as {__modules__[name]}")
        __modules__[name] = cls
        return cls

    return decorator


def find(name: str):
    """Look up a registered class by name; dotted paths are imported."""
    if name in __modules__:
        return __modules__[name]
    if "." in name:
        import importlib

        module_name, cls_name = name.rsplit(".", 1)
        module = importlib.import_module(module_name)
        return getattr(module, cls_name)
    raise KeyError(f"Unknown module: {name!r}; known: {sorted(__modules__)}")


def require_cuda() -> torch.device:
    """The CUDA device for a main-path entry point; raises without one.
    Entry points never pick the CPU silently."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "open_diffusiongs_tpu_torch: no CUDA device is available "
            "(torch.cuda.is_available() is False); the sampling path runs "
            "on the GPU only")
    return torch.device("cuda", torch.cuda.current_device())


def select_device(device=None) -> torch.device:
    """An entry point's device: the CUDA device (`require_cuda`, which
    raises without one) unless the caller names another, e.g. "cpu"."""
    if device is None or torch.device(device).type == "cuda":
        return require_cuda()
    return torch.device(device)


def _register_builtins():
    """Import submodules for their @register side effects."""
    from .data import objaverse as _obja  # noqa: F401
    from .data import re10k as _re10k  # noqa: F401
    from .systems import object_system as _obj  # noqa: F401
    from .systems import scene_system as _scene  # noqa: F401
