"""Tensor parallel on one host: sharding rules (``sharding``) and the
collectives between shards (``collectives``)."""
