"""Launch layer: the multi-process chain runner, the elastic runner and
the sLDA dry-run reports."""
