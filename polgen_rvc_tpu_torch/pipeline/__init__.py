"""Engine, chunk planner, output path and builders."""
