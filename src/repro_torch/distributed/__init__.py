from .sharded_index import distributed_query, distributed_search, shard_index
