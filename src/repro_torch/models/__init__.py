"""The port's LM stack: configuration, registry, layers and the serving
paths (prefill and decode) of the dense transformer, of rwkv6 and of the
RG-LRU hybrid (recurrentgemma)."""
