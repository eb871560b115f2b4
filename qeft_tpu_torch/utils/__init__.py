from qeft_tpu_torch.utils.profiling import GLOBAL, Telemetry, phase_timer, profile_trace

__all__ = ["GLOBAL", "Telemetry", "phase_timer", "profile_trace"]
