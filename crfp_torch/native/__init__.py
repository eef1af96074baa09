"""ctypes bindings and lazy g++ build of the host preprocessing library."""

from crfp_torch.native.bindings import (
    crop_normalize_flip_f32,
    fill_fovea_f32,
    native_available,
    resize_bicubic_u8,
)

__all__ = [
    "native_available",
    "resize_bicubic_u8",
    "crop_normalize_flip_f32",
    "fill_fovea_f32",
]
