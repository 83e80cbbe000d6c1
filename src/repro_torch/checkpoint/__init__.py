"""Per-chain checkpoints for communication-free chains, in the reference
package's on-disk layout (either package restores the other's files)."""
from .store import (save_checkpoint, restore_checkpoint, restore_chain,
                    latest_step, list_chains, read_manifest,
                    restore_elastic, sweep_stale, CheckpointManager,
                    AsyncCheckpointManager, CheckpointNotFoundError)

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_chain",
           "latest_step", "list_chains", "read_manifest",
           "restore_elastic", "sweep_stale", "CheckpointManager",
           "AsyncCheckpointManager", "CheckpointNotFoundError"]
