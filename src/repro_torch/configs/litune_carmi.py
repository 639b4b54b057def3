"""The paper's own tuning target: CARMI-family learned index (Table 2)."""
from repro_torch.core.litune import LITuneConfig

CONFIG = LITuneConfig(index_type="carmi")
PARAM_DIMS = 13  # 10 continuous, 2 integer, 1 hybrid continuous/discrete
