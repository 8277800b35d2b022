"""PyTorch/CUDA port of the SCP/MPC engine (counterpart of ``scp_tpu``).

Module paths and function names mirror ``scp_tpu`` so a reader finds the
counterpart of a module by path. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

The solver's float32 needs true float32 products (positions ~30 m would
carry ~0.01 m of TF32 error into the collision constraints), so TF32 matmuls
are switched off at import and :func:`assert_full_f32` re-checks it.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False


def assert_full_f32() -> None:
    """Raise if TF32 matmuls were re-enabled after import."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 must stay False: the f32 "
            "IPM relies on full-precision products")


def require_device(device) -> torch.device:
    """Resolve ``device``; a CUDA request without a GPU raises (there is no
    silent fallback to the CPU anywhere in the package)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "scp_tpu_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' explicitly to run on the "
            "host")
    return dev
