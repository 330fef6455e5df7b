from .flow import FlowGraph, FlowJob, FlowJobsMap, solve_joint  # noqa: F401
from .jobs import Job, JobManager, merge_assignments  # noqa: F401
from .native import NativeFlowGraph, make_flow_graph  # noqa: F401
