"""The port's model stack: dense GQA decoder-only LMs (granite-3-2b;
glm4-9b, codeqwen1.5-7b and qwen2-72b with q/k/v biases), their MoE
variants (qwen2-moe-a2.7b; deepseek-v2-lite-16b with MLA), the VLM
backbone (qwen2-vl-72b), the encoder-decoder (whisper-large-v3), Mamba-2
SSM LMs (mamba2-1.3b) and the Jamba hybrid (jamba-1.5-large-398b)."""

from .model import Model

__all__ = ["Model"]
