from .raft import (  # noqa: F401
    RaftConfig,
    WeightedRAFT,
    encode_template,
    init_raft_params,
    weighted_raft_forward,
)
from .convert import params_from_jax_numpy, params_to_jax_numpy  # noqa: F401
from .corr import (  # noqa: F401
    BlockedCorr,
    LocalCorrVolumes,
    build_local_corr,
    corr_lookup,
    corr_lookup_alternate,
    corr_lookup_local,
    corr_lookup_local_blocked,
    corr_pyramid_fused,
)
