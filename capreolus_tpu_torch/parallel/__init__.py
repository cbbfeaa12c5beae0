from capreolus_tpu_torch.parallel.sharded_search import ShardedDeviceIndex, sharded_bm25_topk, sharded_search

__all__ = ["ShardedDeviceIndex", "sharded_bm25_topk", "sharded_search"]
