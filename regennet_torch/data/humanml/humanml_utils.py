"""Body-part masks over the HumanML3D 263-dim feature layout (the port's
copy of regennet_tpu/data/humanml/humanml_utils.py).

Parity with the reference mask tables (reference: data_loaders/
humanml_utils.py) used by the upper_body editing mode: which of the 263
feature dims belong to the lower-body joints. Built programmatically from
the feature layout (root 4 | ric (J-1)*3 | rot6d (J-1)*6 | vel J*3 |
contacts 4) instead of hardcoded index lists.
"""

from __future__ import annotations

import numpy as np

NUM_HML_JOINTS = 22
HML_LOWER_BODY_JOINTS = [0, 1, 2, 4, 5, 7, 8, 10, 11]  # pelvis, legs, feet
HML_UPPER_BODY_JOINTS = [
    j for j in range(NUM_HML_JOINTS) if j not in HML_LOWER_BODY_JOINTS
]

HML_FEATURE_DIM = 4 + (NUM_HML_JOINTS - 1) * 3 + (NUM_HML_JOINTS - 1) * 6 \
    + NUM_HML_JOINTS * 3 + 4


def hml_joint_feature_mask(joints) -> np.ndarray:
    """Boolean [263] mask of the feature dims owned by the given joints."""
    J = NUM_HML_JOINTS
    mask = np.zeros(HML_FEATURE_DIM, dtype=bool)
    joints = set(int(j) for j in joints)
    if 0 in joints:
        mask[0:4] = True       # root rot-vel, planar vel, height
        mask[259:263] = True   # foot contacts ride with the lower body
    ric0, rot0 = 4, 4 + (J - 1) * 3
    vel0 = rot0 + (J - 1) * 6
    for j in joints:
        if j > 0:
            mask[ric0 + (j - 1) * 3 : ric0 + j * 3] = True
            mask[rot0 + (j - 1) * 6 : rot0 + j * 6] = True
        mask[vel0 + j * 3 : vel0 + (j + 1) * 3] = True
    return mask


HML_LOWER_BODY_MASK = hml_joint_feature_mask(HML_LOWER_BODY_JOINTS)
HML_UPPER_BODY_MASK = ~HML_LOWER_BODY_MASK
HML_ROOT_BINARY = hml_joint_feature_mask([0])
# the reference's root mask excludes the 4 foot-contact dims
# (reference: data_loaders/humanml_utils.py:43-46 ends with [False]*4)
HML_ROOT_MASK = HML_ROOT_BINARY.copy()
HML_ROOT_MASK[259:263] = False
