from repro_torch.runtime.block_pool import (BlockPool,  # noqa: F401
                                            blocks_for_tokens)
from repro_torch.runtime.serve_loop import (Request, Scheduler,  # noqa: F401
                                            ServeStats, serve, serve_batch,
                                            serve_continuous)
from repro_torch.runtime.steps import (make_admit_step,  # noqa: F401
                                       make_chunk_prefill_step,
                                       make_decode_step, make_prefill_step)
