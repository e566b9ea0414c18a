"""gRPC wiring of the WiserEngine service (the port's copy of
wiser_tpu/serve/protocol.py; the reference's protos/qq.proto,
grpc_server_impl.h and grpc_client_impl.h).

The handlers and client stubs are registered by hand against the
generated message classes (wiser_pb2), which is what a *_pb2_grpc.py
module would do. grpc and protobuf are imported inside the functions
that use them, so the module imports where neither is installed.
"""

from __future__ import annotations

from wiser_tpu_torch.types import SearchQuery

SERVICE = "wiser.WiserEngine"


def add_service(server, servicer) -> None:
    """Register servicer's StreamingSearch / BatchSearch / UnarySearch /
    AddDocument / Echo on a grpc.Server."""
    import grpc

    from wiser_tpu_torch.serve import wiser_pb2 as pb

    stream = grpc.stream_stream_rpc_method_handler
    unary = grpc.unary_unary_rpc_method_handler
    handlers = {
        "StreamingSearch": stream(
            servicer.StreamingSearch,
            request_deserializer=pb.SearchRequest.FromString,
            response_serializer=pb.SearchReply.SerializeToString),
        "BatchSearch": stream(
            servicer.BatchSearch,
            request_deserializer=pb.SearchRequestBatch.FromString,
            response_serializer=pb.SearchReplyBatch.SerializeToString),
        "UnarySearch": unary(
            servicer.UnarySearch,
            request_deserializer=pb.SearchRequest.FromString,
            response_serializer=pb.SearchReply.SerializeToString),
        "AddDocument": unary(
            servicer.AddDocument,
            request_deserializer=pb.AddDocumentRequest.FromString,
            response_serializer=pb.StatusReply.SerializeToString),
        "Echo": unary(
            servicer.Echo,
            request_deserializer=pb.EchoData.FromString,
            response_serializer=pb.EchoData.SerializeToString),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),))


class WiserEngineStub:
    """The client stub (a *_pb2_grpc.WiserEngineStub) over a grpc.Channel."""

    def __init__(self, channel):
        from wiser_tpu_torch.serve import wiser_pb2 as pb

        def method(kind, name, req, rep):
            return getattr(channel, kind)(
                f"/{SERVICE}/{name}", request_serializer=req.SerializeToString,
                response_deserializer=rep.FromString)

        self.StreamingSearch = method("stream_stream", "StreamingSearch",
                                      pb.SearchRequest, pb.SearchReply)
        self.BatchSearch = method("stream_stream", "BatchSearch",
                                  pb.SearchRequestBatch, pb.SearchReplyBatch)
        self.UnarySearch = method("unary_unary", "UnarySearch",
                                  pb.SearchRequest, pb.SearchReply)
        self.AddDocument = method("unary_unary", "AddDocument",
                                  pb.AddDocumentRequest, pb.StatusReply)
        self.Echo = method("unary_unary", "Echo", pb.EchoData, pb.EchoData)


def query_from_request(req) -> SearchQuery:
    return SearchQuery(
        terms=list(req.terms),
        n_results=req.n_results or 5,
        return_snippets=req.return_snippets,
        n_snippet_passages=req.n_snippet_passages or 3,
        is_phrase=req.is_phrase,
    )


def request_from_query(q: SearchQuery):
    from wiser_tpu_torch.serve import wiser_pb2 as pb

    return pb.SearchRequest(
        terms=q.terms, n_results=q.n_results,
        return_snippets=q.return_snippets,
        n_snippet_passages=q.n_snippet_passages, is_phrase=q.is_phrase)


def fill_reply(reply, result) -> None:
    """Append result's entries to a SearchReply message."""
    for e in result.entries:
        reply.entries.add(doc_id=e.doc_id, snippet=e.snippet,
                          doc_score=e.doc_score)


def reply_from_result(result):
    from wiser_tpu_torch.serve import wiser_pb2 as pb

    reply = pb.SearchReply()
    fill_reply(reply, result)
    return reply
