"""launches_per_job: the port's kernel launch counters
(``ops/cuda_scorer.launch_counts``) over the window, a job (program_counter)."""


def read(run):
    if not run.jobs:
        return None
    return sum(run.launches.values()) / len(run.jobs)
