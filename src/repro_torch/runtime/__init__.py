from repro_torch.runtime.serve_loop import (Request, ServeStats,  # noqa: F401
                                            serve, serve_batch)
from repro_torch.runtime.steps import (make_decode_step,  # noqa: F401
                                       make_prefill_step)
