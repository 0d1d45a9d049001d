"""The port's LM stack: configuration, registry, layers and the serving
paths (prefill and decode) of the dense transformer and of rwkv6."""
