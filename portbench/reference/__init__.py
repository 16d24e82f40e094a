"""The plain reference: the models, Adam and the merge rules written from
their equations in plain PyTorch, f32 with TF32 off. It imports nothing of
the port (``distkeras_tpu_torch``, ``distkeras_torch``) or of the JAX
package, and takes nothing the port made: the harness hands it the seeded
weights and traffic it hands the port.

``precision="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 with one scale per tensor (the step below the
configurations' bf16), the rest as in f32.
"""
