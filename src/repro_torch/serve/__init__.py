"""Serving steps of the port: LM prefill and decode (``serve.step``)."""
