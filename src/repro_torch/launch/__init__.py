"""Launch layer: the multi-process chain runner, the elastic runner, the
sLDA dry-run reports, the LM train / prefill / decode steps and trainer,
and the multi-device half: the production meshes, the sharding rules,
the per-device cost counter and the LM dry-run."""
