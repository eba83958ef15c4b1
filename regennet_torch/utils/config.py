"""Static path constants (the port's copy of regennet_tpu/utils/config.py;
reference: utils/config.py:1-20)."""

import os

BODY_MODELS_DIR = os.environ.get("REGENNET_BODY_MODELS", "./body_models")

SMPL_DATA_PATH = os.path.join(BODY_MODELS_DIR, "smpl")
SMPL_MODEL_PATH = os.path.join(SMPL_DATA_PATH, "SMPL_NEUTRAL.pkl")
SMPL_KINTREE_PATH = os.path.join(SMPL_DATA_PATH, "kintree_table.pkl")
JOINT_REGRESSOR_TRAIN_EXTRA = os.path.join(SMPL_DATA_PATH, "J_regressor_extra.npy")

SMPLX_MODEL_PATH = os.path.join(BODY_MODELS_DIR, "smplx")
SMPLX_KINTREE_PATH = os.path.join(SMPLX_MODEL_PATH, "SMPLX_NEUTRAL.npz")

NUM_BETAS = 10
GENDERS = ["neutral", "male", "female"]
