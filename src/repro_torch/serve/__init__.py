"""Serving layer of the port: the batched decode engine and the strategy
query service (counterparts of ``repro.serve``'s).

:class:`ServeEngine` / :class:`Request` (:mod:`repro_torch.serve.engine`)
decode language models on the card.  :class:`StrategyService` /
:class:`ServiceResult` (:mod:`repro_torch.serve.strategy`) serve strategy
verdicts on a device through K1 and K2, behind the admission layer
(:class:`AdmissionQueue` / :class:`Deadline` / :class:`RetryPolicy` and the
typed :class:`Overloaded` / :class:`DeadlineExceeded` errors,
:mod:`repro_torch.serve.admission`) and the crash-consistent
:class:`ArenaCache` (:mod:`repro_torch.serve.cache`).
"""
from .admission import (AdmissionQueue, Deadline, DeadlineExceeded,
                        Overloaded, RetryPolicy)
from .cache import ArenaCache
from .engine import Request, ServeEngine
from .strategy import ServiceResult, StrategyService

__all__ = ["ServeEngine", "Request", "StrategyService", "ServiceResult",
           "AdmissionQueue", "Deadline", "RetryPolicy", "Overloaded",
           "DeadlineExceeded", "ArenaCache"]
