"""Pure-Python control-plane pieces of the port (padding plan, chunked
prefill policy).  Unlike ``repro.core`` this package imports nothing
eagerly."""
