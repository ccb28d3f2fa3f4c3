"""KV-cache management of the port (survey dim 2): selection, budgets,
merging, paging, the radix prefix tree and tiered storage. Port of
``repro.core.kv_cache``, with the reference's exports."""
from repro_torch.core.kv_cache.selection import (
    SELECTORS, select_snapkv, select_h2o, select_streaming, select_l2,
    oracle_topk)
from repro_torch.core.kv_cache.budget import (
    uniform_budgets, pyramid_budgets, adaptive_budgets, cake_layer_scores)
from repro_torch.core.kv_cache.merging import d2o_merge, chai_cluster, \
    chai_shared_attention
from repro_torch.core.kv_cache.paged import (
    BlockAllocator, PagedKVPool, SeqBlocks, OutOfBlocksError,
    fragmentation_waste)
from repro_torch.core.kv_cache.prefix_cache import RadixPrefixCache, RadixNode
from repro_torch.core.kv_cache.tiered import (
    TieredKVStore, TierStats, prefetch_schedule)
