"""io layer of the port (mirrors rawphotoforge_tpu.io).

Public surface (each re-exported from its module):

* image_io: decode_image / encode_image / read_image / write_image
  (JPEG/PNG/WebP/TIFF/PPM16 <-> linear planar f32)
* dng: read_dng / write_dng / extract_preview / RawImage
* raw: read_raw / parse_raw / is_raw_image / decode_embedded_preview
"""

from .dng import RawImage, extract_preview, read_dng, write_dng  # noqa: F401
from .image_io import (  # noqa: F401
    decode_image, encode_image, read_image, write_image,
)
from .raw import (  # noqa: F401
    decode_embedded_preview, is_raw_image, parse_raw, read_raw,
)
