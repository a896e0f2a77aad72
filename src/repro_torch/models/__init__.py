from repro_torch.models.model import (DecoderParams, Runtime, decode_step,
                                      forward, init_cache, init_params)
