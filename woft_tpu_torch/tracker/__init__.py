from .woft import (  # noqa: F401
    TrackerParams,
    TrackerState,
    WOFTTracker,
    build_shared_multi_step,
    build_track_step,
    tracker_init_state,
)
from .window import WOFTWindowTracker  # noqa: F401
from .window_step import (  # noqa: F401
    WindowParams,
    build_window_batch_step,
    build_window_track_step,
    stack_window_states,
    window_init_state,
    window_params_for_mask,
)
