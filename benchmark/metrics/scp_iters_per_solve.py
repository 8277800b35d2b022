"""Mean SCP iterations an instance-step (``StepOutput.scp_iters``) over the
traced run's window (layer: SCP loop)."""


def read(record):
    return record.get("scp_iters_mean")
