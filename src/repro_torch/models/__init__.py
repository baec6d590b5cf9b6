from . import layers, model, moe, ssm, xlstm
from .model import (Decoder, backbone, decode_step, embed_inputs, init_cache,
                    init_params, lm_loss, params_from_numpy, params_to_numpy,
                    prefill, train_loss)
