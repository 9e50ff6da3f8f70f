"""Online data flywheel (DESIGN.md §15), counterpart of `repro.flywheel`:
measured runtimes feed the corpus as delta shards, the cost model
warm-start fine-tunes on the base+delta stream, and the next search
round spends its hardware budget where the refreshed model is least
certain.

measure  — `MeasurementLog` taps every charged `HardwareEstimator` eval
store    — `MeasurementLog.flush_to` appends a corpus delta shard
           (`CorpusWriter.append_delta`, chain-verified manifests)
retrain  — `fine_tune` warm-starts from the latest checkpoint on the
           `StreamingCorpus.with_deltas()` stream with a short warmup
search   — `AcquisitionEstimator` (repro_torch.search) routes the rest of
           the `BudgetMeter` seconds to the highest-variance candidates
loop     — `run_flywheel` chains k measure→append→fine-tune→search
           rounds (`launch/flywheel.py` is the CLI driver)
"""
from repro_torch.flywheel.log import MeasurementLog
from repro_torch.flywheel.loop import FlywheelConfig, FlywheelResult, \
    run_flywheel
from repro_torch.flywheel.retrain import fine_tune, tile_val_loss

__all__ = [
    "FlywheelConfig",
    "FlywheelResult",
    "MeasurementLog",
    "fine_tune",
    "run_flywheel",
    "tile_val_loss",
]
