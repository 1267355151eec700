from .wrapper import RaftFlow  # noqa: F401
from .cache import FlowCache, identify_image  # noqa: F401
from .external import ExternalFlowWrapper  # noqa: F401
