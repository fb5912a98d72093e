from repro_torch.artifact.store import (Artifact, ArtifactError,
                                        SCHEMA_VERSION, copy_artifact,
                                        find_artifacts, load_artifact,
                                        save_artifact, verify_artifact)
