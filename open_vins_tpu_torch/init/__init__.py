"""Visual-inertial initialization: static, dynamic, the router between them
and the background initializer with its catch-up replay."""
