"""Host utilities: video and flow I/O, timing, and drawing (``vis``).

``GeneralVideoCapture``, ``VideoWriter`` and the png flow files need
``cv2``, which each loads when it is called, so importing the package
never needs it."""

from .io import (  # noqa: F401
    GeneralVideoCapture, VideoWriter, read_flow_png, write_flow_png)
from .timing import time_measurer, device_time_measurer  # noqa: F401
