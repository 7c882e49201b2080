from emx_torch.io.tiff import read_tiff, write_tiff
from emx_torch.io.dm import DMFile, read_dm, dm_image, write_dm
from emx_torch.io.manifest import Manifest, build_manifest, split_manifest

__all__ = [
    "read_tiff",
    "write_tiff",
    "DMFile",
    "read_dm",
    "dm_image",
    "write_dm",
    "Manifest",
    "build_manifest",
    "split_manifest",
]
