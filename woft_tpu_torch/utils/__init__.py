"""Host utilities: video and flow I/O, timing, drawing (``vis``), logging,
seeding, crash notifications and profiling (the program's stage spans:
``span``, ``recording``, ``recorded_spans``; ``trace_step``).

``GeneralVideoCapture``, ``VideoWriter`` and the png flow files need
``cv2``, which each loads when it is called, so importing the package
never needs it."""

from .io import (  # noqa: F401
    GeneralVideoCapture, VideoWriter, read_flow_png, write_flow_png)
from .timing import time_measurer  # noqa: F401
from .logging_utils import SparseExceptionLogger, with_debugger  # noqa: F401
from .random_utils import tmp_np_seed  # noqa: F401
from .notifications import send_notification, with_notification  # noqa: F401
from .profiling import (  # noqa: F401
    clear_spans, recorded_spans, recording, span, trace_step)
