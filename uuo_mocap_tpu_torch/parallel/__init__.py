from uuo_mocap_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    sharded_hypothesis_solve,
    sharded_train_step,
)
