"""Job condition state machine helpers.

Analog of pkg/utils/utils.go:78-248: append/replace conditions with
transition filtering (mutually-exclusive Running/Restarting/Queuing handling,
``filterOutCondition`` utils.go:201-223), terminal-state predicates, and the
``{job}-{tasktype}-{index}`` naming convention.
"""
from __future__ import annotations

import datetime as _dt
from typing import Optional

from tpu_on_k8s_torch.api.core import utcnow
from tpu_on_k8s_torch.api.types import (
    JobCondition,
    JobConditionType,
    JobStatus,
    TaskType,
    TorchJob,
)


def gen_general_name(job_name: str, task_type: TaskType, index: int) -> str:
    """Pod/service name ``{job}-{type}-{idx}`` (reference utils.go:78-80)."""
    return f"{job_name}-{task_type.value.lower()}-{index}"


def get_condition(status: JobStatus, cond_type: JobConditionType) -> Optional[JobCondition]:
    for c in status.conditions:
        if c.type == cond_type:
            return c
    return None


def has_condition(status: JobStatus, cond_type: JobConditionType) -> bool:
    c = get_condition(status, cond_type)
    return c is not None and c.status == "True"


def is_succeeded(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.SUCCEEDED)


def is_failed(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.FAILED)


def is_finished(status: JobStatus) -> bool:
    return is_succeeded(status) or is_failed(status)


def is_running(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.RUNNING)


def is_queuing(status: JobStatus) -> bool:
    return has_condition(status, JobConditionType.QUEUING)


def needs_coordinator_enqueue(status: JobStatus) -> bool:
    """A job enters the coordinator only before it first leaves Created/Queuing
    (reference utils.go:134-137 NeedEnqueueToCoordinator)."""
    if is_finished(status) or is_running(status):
        return False
    return not any(
        c.type in (JobConditionType.RUNNING, JobConditionType.RESTARTING)
        and c.status == "True"
        for c in status.conditions
    )


def update_job_conditions(
    status: JobStatus,
    cond_type: JobConditionType,
    reason: str = "",
    message: str = "",
    *,
    cond_status: str = "True",
    now: Optional[_dt.datetime] = None,
) -> bool:
    """Set ``cond_type`` on the status, demoting conflicting conditions
    (reference utils.go filterOutCondition semantics):

    * setting Running sets any Restarting/Queuing condition to "False";
    * setting Restarting demotes Running;
    * setting a terminal condition (Succeeded/Failed) demotes Running/Restarting.

    Returns True if anything changed.
    """
    now = now or utcnow()
    new = JobCondition(
        type=cond_type,
        status=cond_status,
        reason=reason,
        message=message,
        last_transition_time=now,
        last_update_time=now,
    )
    demote = {
        JobConditionType.RUNNING: {JobConditionType.RESTARTING, JobConditionType.QUEUING},
        JobConditionType.RESTARTING: {JobConditionType.RUNNING},
        JobConditionType.SUCCEEDED: {JobConditionType.RUNNING, JobConditionType.RESTARTING},
        JobConditionType.FAILED: {JobConditionType.RUNNING, JobConditionType.RESTARTING},
        JobConditionType.QUEUING: {JobConditionType.RUNNING},
    }.get(cond_type, set()) if cond_status == "True" else set()

    changed = False
    found = False
    for c in status.conditions:
        if c.type == cond_type:
            found = True
            if c.status != new.status or c.reason != reason or c.message != message:
                if c.status != new.status:
                    c.last_transition_time = now
                c.status, c.reason, c.message = new.status, reason, message
                c.last_update_time = now
                changed = True
        elif c.type in demote and c.status == "True":
            c.status = "False"
            c.last_transition_time = now
            c.last_update_time = now
            changed = True
    if not found:
        status.conditions.append(new)
        changed = True
    return changed


def mark_created(job: TorchJob) -> bool:
    return update_job_conditions(
        job.status,
        JobConditionType.CREATED,
        reason="JobCreated",
        message=f"TorchJob {job.metadata.name} is created.",
    )
