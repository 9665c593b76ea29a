"""The gRPC method registry of the scheduler and executor services
(``rpc``), which the executor needs to poll a scheduler. The scheduler
itself comes with ROADMAP queue 1, item 9d."""
