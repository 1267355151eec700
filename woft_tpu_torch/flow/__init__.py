from .wrapper import RaftFlow  # noqa: F401
from .external import ExternalFlowWrapper  # noqa: F401
