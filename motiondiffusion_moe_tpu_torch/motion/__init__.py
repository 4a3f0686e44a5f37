"""Motion codec: quaternion algebra, skeleton kinematics, feature encoding
(raw joints -> features) and decoding (features -> joints)."""

from motiondiffusion_moe_tpu_torch.motion.quaternion import (  # noqa: F401
    qinv,
    qnormalize,
    qmul,
    qrot,
    qbetween,
    qfix,
    qeuler,
    euler2quat,
    expmap_to_quaternion,
    quaternion_to_matrix,
    quaternion_to_cont6d,
    cont6d_to_matrix,
    qpow,
    qslerp,
    lerp,
)
from motiondiffusion_moe_tpu_torch.motion.params import (  # noqa: F401
    T2M_KINEMATIC_CHAIN,
    T2M_RAW_OFFSETS,
    KIT_KINEMATIC_CHAIN,
    KIT_RAW_OFFSETS,
    get_skeleton_params,
)
from motiondiffusion_moe_tpu_torch.motion.skeleton import Skeleton  # noqa: F401
from motiondiffusion_moe_tpu_torch.motion.recover import (  # noqa: F401
    recover_root_rot_pos,
    recover_from_ric,
    recover_from_rot,
)
