from regennet_torch.parallel.mesh import (  # noqa: F401
    Layout,
    make_mesh,
    process_shard_info,
    setup,
    shard_model_,
)
