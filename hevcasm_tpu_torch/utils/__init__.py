from .psnr import psnr
from .tensor import as_tensor, first_min

__all__ = ["psnr", "as_tensor", "first_min"]
