"""Synthetic data and the checkpointable input pipeline (port of
``repro.data``'s numpy generators and ``DataPipeline``)."""
from repro_torch.data.pipeline import (DataPipeline, DrawnBatches,
                                       IteratorState, shard_batch)
from repro_torch.data.synthetic import (GLUE_SUITE, GLUETaskConfig,
                                        LMTaskConfig, SyntheticGLUE,
                                        SyntheticLM)
