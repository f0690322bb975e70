"""The paper's vector fields and the ODE image classifier."""
