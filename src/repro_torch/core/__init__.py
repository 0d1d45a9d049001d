"""Simulator core of the port: rng → f32math → topology → tasks → deque →
stealing → linkstate → constellation → arrivals → tracing → simulator, each
(but f32math, the reference's float32 `log` op by op) the counterpart of
the `repro.core` module of the same name."""
