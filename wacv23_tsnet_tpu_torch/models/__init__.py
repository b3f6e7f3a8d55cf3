from .api import TSNet
from .tsnet import (TSNetModules, decode_with_sources, encode_sources,
                    tsnet_forward, tsnet_forward_clip)

__all__ = ["TSNet", "TSNetModules", "decode_with_sources", "encode_sources",
           "tsnet_forward", "tsnet_forward_clip"]
