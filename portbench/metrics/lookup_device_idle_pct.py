"""``device_idle_pct``, read where the lookup-only cell reports it (its end-to-end
metric is not ``ops_per_s`` there, so the metric takes a name of its
own)."""
from .device_idle_pct import read  # noqa: F401
