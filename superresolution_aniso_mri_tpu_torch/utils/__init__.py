"""Host utilities: image IO, image grids, the stall watchdog."""
from .nifti import (read_image, read_metaimage, read_nifti, write_image,
                    write_metaimage, write_nifti)

__all__ = ["read_image", "read_metaimage", "read_nifti", "write_image",
           "write_metaimage", "write_nifti"]
