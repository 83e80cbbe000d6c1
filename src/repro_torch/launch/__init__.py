"""Launch layer: the multi-process chain runner, the elastic runner, the
sLDA dry-run reports, and the LM train / prefill / decode steps and
trainer."""
