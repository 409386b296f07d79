"""Optimizers and schedules over parameter trees (port of
``repro.optim``: Adam / AdamW, global-norm clipping, learning-rate
schedules)."""
from repro_torch.optim.adam import (AdamState, adam_init, adam_update,
                                    adamw_init, apply_updates,
                                    clip_by_global_norm)
from repro_torch.optim.schedule import (constant_schedule, cosine_schedule,
                                        linear_warmup_linear_decay)
from repro_torch.optim.tree import tree_leaves, tree_map, tree_unflatten
