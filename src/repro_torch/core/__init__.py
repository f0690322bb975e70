"""Explicit RK integrators, checkpoint schedules, adjoint policies and CNFs."""
