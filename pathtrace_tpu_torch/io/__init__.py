from pathtrace_tpu_torch.io.exr import read_exr, write_exr, save_aovs_exr, load_aovs_exr
from pathtrace_tpu_torch.io.bmp import encode_bmp, write_bmp, save_aovs_bitmaps

__all__ = [
    "read_exr",
    "write_exr",
    "save_aovs_exr",
    "load_aovs_exr",
    "encode_bmp",
    "write_bmp",
    "save_aovs_bitmaps",
]
