from .tsnet import (TSNetModules, decode_with_sources, encode_sources,
                    tsnet_forward, tsnet_forward_clip)

__all__ = ["TSNetModules", "decode_with_sources", "encode_sources",
           "tsnet_forward", "tsnet_forward_clip"]
