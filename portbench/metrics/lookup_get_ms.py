"""``get_ms``, read where the lookup-only cell reports it (its end-to-end
metric is not ``ops_per_s`` there, so the metric takes a name of its
own)."""
from .get_ms import read  # noqa: F401
