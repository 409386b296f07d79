"""The paper's quantization library, ported to PyTorch: policies, the
fake-quantizer with STE / LSQ gradients, range estimation, PEG,
calibration, QAT, AdaRound, mixed-precision accounting, the PTQ pipeline
and the integer deploy path (see ``repro.core`` for the reference)."""
from repro_torch.core.calibration import (Mode, QuantCtx, build_act_state,
                                          build_weight_state, collect_ranges)
from repro_torch.core.deploy import (ActQuant, KVQuant, QTensor,
                                     act_quant_for, build_deploy, is_packed,
                                     kv_quant_for, pack_linear)
from repro_torch.core.pipeline import QuantizedModel, ptq
from repro_torch.core.quant_config import (A8_DEFAULT, A16_DEFAULT, FP32,
                                           W8_DEFAULT, Granularity,
                                           QuantizationPolicy,
                                           QuantizerConfig, RangeEstimator,
                                           fp32_policy,
                                           low_bit_weight_policy,
                                           mixed_precision_policy,
                                           peg_config, peg_policy,
                                           w8a8_policy)
from repro_torch.core.quantizer import (QuantParams, dequantize, fake_quant,
                                        params_from_range, quant_error,
                                        quantize, reduce_range)
