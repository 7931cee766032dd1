"""Host runtime: config registry, metrics, INFO fields, thread pools, debug hooks.

device-native replacement for the reference's vmsdk runtime layer
(vmsdk/src/ — thread pools, config registry, info fields, debug pausepoints).
The Valkey module ABI, blocked clients, fork handling, and malloc
interposition from the reference have no equivalent here: the engine is its
own process, so the runtime is a plain host-side service layer around the
JAX device state.
"""
