"""Host-side data runtime: the native PNG prefetch ring and its fallback."""
