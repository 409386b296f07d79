"""Synthetic data for the paper's experiments (port of ``repro.data``'s
numpy generators)."""
from repro_torch.data.synthetic import (GLUE_SUITE, GLUETaskConfig,
                                        LMTaskConfig, SyntheticGLUE,
                                        SyntheticLM)
