"""ray_tpu_torch.dag — lazy task/actor call graphs.

Reference: ``python/ray/dag/`` (``dag_node.py``, ``function_node.py``,
``class_node.py``, ``input_node.py``) — ``fn.bind(...)`` builds a DAG instead
of executing; ``dag.execute(input)`` walks it, submitting each node as a task
once its upstream refs exist.  The serve deployment-graph and workflow
libraries build on this.
"""

from .node import (ClassMethodNode, ClassNode, DAGNode, FunctionNode,
                   InputNode)

__all__ = ["DAGNode", "FunctionNode", "ClassNode", "ClassMethodNode",
           "InputNode"]
