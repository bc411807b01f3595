from repro_torch.core.objective import (
    LogisticRegression,
    Objective,
    get_objective,
    params_from_flat,
    register_objective,
    registered_objectives,
)
from repro_torch.core.objectives import (
    MLPObjective,
    NonconvexLogistic,
    mlp_lm_objective,
)
from repro_torch.core.svrg import svrg_epoch, run_svrg, sweep_spec as svrg_sweep_spec
from repro_torch.core.asysvrg import (
    AsyRunResult,
    asysvrg_epoch,
    make_delay_schedule,
    run_asysvrg,
)
from repro_torch.core.sweep import (
    ALGOS,
    SweepSpec,
    SweepResult,
    SweepPlan,
    make_grid,
    plan_sweep,
    run_sweep,
)
from repro_torch.core.hogwild import hogwild_epoch, run_hogwild
from repro_torch.core.compression import (
    topk_compress,
    randk_compress,
    int8_compress,
    ErrorFeedbackState,
    compressed_update,
)
from repro_torch.core.distributed import (
    bounded_staleness_epoch,
    init_worker_error_feedback,
    reshape_for_workers,
)

__all__ = [
    "LogisticRegression",
    "Objective",
    "register_objective",
    "get_objective",
    "registered_objectives",
    "params_from_flat",
    "MLPObjective",
    "NonconvexLogistic",
    "mlp_lm_objective",
    "svrg_epoch",
    "run_svrg",
    "svrg_sweep_spec",
    "ALGOS",
    "AsyRunResult",
    "asysvrg_epoch",
    "run_asysvrg",
    "make_delay_schedule",
    "SweepSpec",
    "SweepResult",
    "SweepPlan",
    "make_grid",
    "plan_sweep",
    "run_sweep",
    "hogwild_epoch",
    "run_hogwild",
    "topk_compress",
    "randk_compress",
    "int8_compress",
    "ErrorFeedbackState",
    "compressed_update",
    "bounded_staleness_epoch",
    "init_worker_error_feedback",
    "reshape_for_workers",
]
