from repro_torch.ckpt.checkpoint import (Checkpointer, CorruptCheckpointError,
                                         latest_good_step, latest_step,
                                         read_meta, restore_params,
                                         save_params, verify_checkpoint)
