"""The port's model stack: dense GQA decoder-only LMs (granite-3-2b;
glm4-9b, codeqwen1.5-7b and qwen2-72b with q/k/v biases), their MoE
variant (qwen2-moe-a2.7b) and Mamba-2 SSM LMs (mamba2-1.3b)."""

from .model import Model

__all__ = ["Model"]
