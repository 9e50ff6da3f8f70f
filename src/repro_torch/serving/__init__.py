"""Cost-model prediction serving: content-addressed `PredictionCache`,
`RequestCoalescer`, the replay stream, the `CostModelService` facade
that scores on the card, and the socket layer on top of it
(`CostModelServer` / `CostModelClient`, the reference's wire protocol).

Exports resolve lazily, as in `repro.serving`: importing the protocol or
client side does not pull in torch; `CostModelService` imports the
encoding and model stack on first touch.
"""
import importlib

_EXPORTS = {
    "CacheStats": "repro_torch.serving.cache",
    "PredictionCache": "repro_torch.serving.cache",
    "SnapshotFormatError": "repro_torch.serving.cache",
    "RequestCoalescer": "repro_torch.serving.coalescer",
    "Ticket": "repro_torch.serving.coalescer",
    "CostModelServer": "repro_torch.serving.server",
    "FaultPolicy": "repro_torch.serving.server",
    "FrameError": "repro_torch.serving.server",
    "ServerStats": "repro_torch.serving.server",
    "CostModelClient": "repro_torch.serving.client",
    "ClientError": "repro_torch.serving.client",
    "DeadlineExceeded": "repro_torch.serving.client",
    "Overloaded": "repro_torch.serving.client",
    "ProtocolError": "repro_torch.serving.client",
    "ServerShutdown": "repro_torch.serving.client",
    "WorkerFailure": "repro_torch.serving.client",
    "BucketStats": "repro_torch.serving.service",
    "CostModelService": "repro_torch.serving.service",
    "PendingRequest": "repro_torch.serving.service",
    "ServiceStats": "repro_torch.serving.service",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    target = _EXPORTS.get(name)
    if target is not None:
        value = getattr(importlib.import_module(target), name)
        globals()[name] = value      # cache: next access skips __getattr__
        return value
    try:                             # `repro_torch.serving.replay` access
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise AttributeError(
            f"module 'repro_torch.serving' has no attribute {name!r}") \
            from None


def __dir__():
    return sorted(set(globals()) | set(__all__))
