"""Dense decoder LM over stacked-unit parameter dicts."""
from repro_torch.models.transformer import (client_forward, forward_from_cut,
                                            init_params, loss_fn,
                                            merge_params, param_count,
                                            server_forward, split_dims,
                                            split_params, untie_params)
