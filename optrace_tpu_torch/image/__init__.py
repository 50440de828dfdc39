"""Image classes (counterpart of ``optrace_tpu/image``)."""

from .base_image import BaseImage  # noqa: F401
from .scalar_image import ScalarImage  # noqa: F401
from .grayscale_image import GrayscaleImage  # noqa: F401
from .rgb_image import RGBImage  # noqa: F401
from .render_image import RenderImage  # noqa: F401
