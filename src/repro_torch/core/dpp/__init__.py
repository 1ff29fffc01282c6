from repro_torch.core.dpp.master import (
    DPPMaster, SessionSpec, SessionState, Split, SplitFailure,
    FailureReport,
    REPORT_OK, REPORT_WORKER_LOST, REPORT_DATA_ERROR,
)
from repro_torch.core.dpp.autoscale import (
    Decision, ElasticController, ElasticPolicy, Observation,
)
from repro_torch.core.dpp.worker import DPPWorker, WorkerMetrics
from repro_torch.core.dpp.client import DPPClient, SessionFailed
from repro_torch.core.dpp.service import DPPService, DPPSession
from repro_torch.core.dpp.prefetch import PrefetchMetrics, PrefetchPlanner
from repro_torch.core.engine import (
    CompiledPlan, EngineStats, NumpyEngine, TorchEngine, TransformEngine,
    compile_pipeline, decode_plan, make_engine,
)
