from repro_torch.runtime.async_serve import (AsyncServer,  # noqa: F401
                                             TokenStream)
from repro_torch.runtime.block_pool import (BlockPool,  # noqa: F401
                                            blocks_for_tokens)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    PreemptionGuard, RestartPolicy, StragglerWatchdog)
from repro_torch.runtime.engine import (DecodeState, Engine,  # noqa: F401
                                        LanePayload, make_engine,
                                        serve_engine)
from repro_torch.runtime.radix_cache import RadixCache  # noqa: F401
from repro_torch.runtime.serve_loop import (Request, Scheduler,  # noqa: F401
                                            ServeStats, serve, serve_batch,
                                            serve_continuous)
from repro_torch.runtime.steps import (make_admit_step,  # noqa: F401
                                       make_chunk_prefill_step,
                                       make_decode_step,
                                       make_encoder_forward,
                                       make_prefill_step, make_swap_steps,
                                       make_train_step)
from repro_torch.runtime.telemetry import (MetricsLogger,  # noqa: F401
                                           QuantHealth, ServeTelemetry,
                                           Tracer)
from repro_torch.runtime.train_loop import (TrainLoopConfig,  # noqa: F401
                                            run_train_loop)
