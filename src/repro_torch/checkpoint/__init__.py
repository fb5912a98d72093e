from repro_torch.checkpoint.checkpoint import (atomic_dir, sha256_bytes,
                                               sha256_file)
