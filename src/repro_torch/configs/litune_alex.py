"""The paper's own tuning target: ALEX-family learned index (Table 2).

Selects the learned-index environment for `repro_torch.core.litune.LITune`.
"""
from repro_torch.core.litune import LITuneConfig

CONFIG = LITuneConfig(index_type="alex")
PARAM_DIMS = 14  # 5 continuous, 3 boolean, 4 integer, 2 discrete-choice
