"""Serving: continuous-batched prefill and decode."""
