"""Sharded frames on ``torch.distributed``: one rank per device, each
setting up its triangle shard and rasterizing its horizontal band."""
