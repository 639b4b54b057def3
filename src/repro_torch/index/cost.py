"""Calibrated per-operation cost constants (ns): the port's own copy of
`repro/index/cost.py`, held equal to it by the tests.

The simulator counts work (model evals, probe steps, shifts, slot copies,
retrained keys, buffer comparisons, cache lines) and converts it to
nanoseconds with these constants.
"""

MODEL_EVAL_NS = 5.0          # linear model evaluation
PROBE_STEP_NS = 3.0          # one exponential/binary search step (in cache)
SHIFT_NS = 2.0               # move one element in a gapped array
SLOT_INIT_NS = 0.5           # allocate/copy one slot during expansion
RETRAIN_PER_KEY_NS = 10.0    # refit models over one key
FIT_PER_KEY_NS = 4.0         # initial build fit per key
BUFFER_CMP_NS = 1.0          # out-of-domain buffer linear-scan comparison
QUERY_BASE_NS = 20.0         # fixed per-query overhead (dispatch etc.)
CACHE_LINE_NS = 60.0         # DRAM cache-line fetch (CARMI)
CACHE_LINE_PREFETCHED_NS = 8.0
KEYS_PER_LINE = 8            # 64B line / 8B key

# Failure thresholds for the ET-MDP cost functions (env-level).
MEM_BUDGET_BYTES = 64e6      # per-reservoir memory budget
RUNTIME_BUDGET_NS = 1e8      # per-step runtime budget ("endless runtime")
