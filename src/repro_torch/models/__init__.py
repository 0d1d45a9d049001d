"""The port's LM stack: configuration, registry, layers and the dense
transformer's serving path (prefill and decode)."""
