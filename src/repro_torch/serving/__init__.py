"""Continuous-batching LM serving (the port of ``repro/serving``'s engine
and samplers). Serving off frozen clustering artifacts waits for ROADMAP
Queue 1 item 7."""
from .engine import Request, ServeConfig, ServingEngine
from .sampling import greedy, sample_top_p

__all__ = ["Request", "ServeConfig", "ServingEngine", "greedy",
           "sample_top_p"]
