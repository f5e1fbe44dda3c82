from .sharded import ShardedHnsw, default_devices, sharded_insert_round_fn

__all__ = ["ShardedHnsw", "default_devices", "sharded_insert_round_fn"]
