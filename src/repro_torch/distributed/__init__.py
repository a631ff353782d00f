"""Distribution on the port: the reference's sharding rules (reckoned for
its meshes, placements on one card) and int8 gradient compression over a
``torch.distributed`` process group."""

from repro_torch.distributed.sharding import (
    ShardingRules,
    constrain,
    logical_sharding,
    make_rules,
    pp_cut_points,
)
from repro_torch.distributed.compress import (
    compress_roundtrip,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
    tree_compress_psum,
)

__all__ = [
    "ShardingRules", "constrain", "logical_sharding", "make_rules",
    "pp_cut_points", "compress_roundtrip", "dequantize_int8",
    "init_error_feedback", "quantize_int8", "tree_compress_psum",
]
