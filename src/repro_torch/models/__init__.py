"""Decoder LMs (dense, MoE, and the Mamba hybrid) over stacked-unit
parameter dicts, and their serving paths."""
from repro_torch.models.transformer import (client_forward, decode_step,
                                            forward_from_cut, init_cache,
                                            init_params, logits_fn, loss_fn,
                                            merge_params, param_count,
                                            prefill, server_forward,
                                            split_dims, split_params,
                                            untie_params)
