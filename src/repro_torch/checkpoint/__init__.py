from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               CheckpointManager, atomic_dir,
                                               restore_checkpoint,
                                               save_checkpoint, sha256_bytes,
                                               sha256_file)
