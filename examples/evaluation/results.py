"""Compare controller evaluation runs (RL vs. PID experts).

Batched-JAX equivalent of /root/reference/examples/evaluation/results.py: the
reference hand-rolls ~600 lines of matplotlib over three hovering-logger
CSVs; here the same dashboards come from ``pyflyt_tpu.utils.results``.

Produce the CSVs with the training CLIs first, e.g.::

    python -m pyflyt_tpu.rl_training.hovering eval \
        --checkpoint runs/hover/best --log_dir runs/rl
    python -m pyflyt_tpu.rl_training.hovering eval-pid-expert --log_dir runs/pid

then run this script with the paths below adjusted.
"""

import sys

from pyflyt_tpu.utils.results import compare_runs, summarize

runs = {
    "RL": "runs/rl/evaluation_results_0.csv",
    "Cascaded PID": "runs/pid/evaluation_results_0.csv",
}
if len(sys.argv) > 1:  # results.py LABEL=path [LABEL=path ...]
    runs = dict(arg.split("=", 1) for arg in sys.argv[1:])

compare_runs(runs, "comparison.png")
print("wrote comparison.png")
for label, stats in summarize(runs).items():
    print(f"{label}: rmse_pos={stats['rmse_pos']:.3f} m  "
          f"rmse_psi={stats['rmse_psi_deg']:.2f} deg  "
          f"total_reward={stats['total_reward']:.1f}")
