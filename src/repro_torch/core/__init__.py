"""Simulator core of the port: rng → topology → tasks → deque → stealing →
linkstate → constellation → simulator, each the counterpart of the
`repro.core` module of the same name."""
