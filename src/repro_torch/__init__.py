"""PyTorch/CUDA port of the PNODE framework (the JAX package ``repro`` is
its reference).  Same subpackage layout: ``core`` (tableaus, RK
integrators, revolve schedules, adjoint policies, CNF, ODE blocks),
``kernels`` (hand-written Hopper kernels, their plain versions and build),
``models`` (the paper's vector fields and classifier), ``optim`` (AdamW),
``convert`` (weights from the JAX package's trees) and ``examples``.

Importing it builds nothing and never imports JAX."""
