"""Serving: the continuous-batching LLM engine (``llm_engine.LLMEngine``)
and its observability plane (``_observability``)."""
