"""Diffusion schedules, posterior math and samplers."""
