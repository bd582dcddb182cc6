"""Host-side helpers of the Tester's dumps."""
