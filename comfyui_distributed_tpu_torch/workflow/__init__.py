"""Workflow engine: API-format graph parsing and execution."""

from comfyui_distributed_tpu_torch.workflow.graph import (  # noqa: F401
    Graph,
    parse_workflow,
)
from comfyui_distributed_tpu_torch.workflow.executor import (  # noqa: F401
    ExecutionResult,
    WorkflowExecutor,
)
