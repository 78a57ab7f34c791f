// Native video decoder: libavformat/libavcodec -> RGB24 / green-plane batches.
//
// The host-side decode path that feeds the TPU encode pipeline (the decord
// replacement; the reference consumed decord at backend/cbas.py:402,425).
// Exposed as a C ABI consumed by ctypes (cbas_tpu_torch/ingest/native/loader.py).
//
// Design:
//  - sequential reads are free (decoder state persists between calls)
//  - random access seeks to the nearest prior keyframe and decodes forward,
//    tracking frame indices via best-effort PTS against the stream timebase
//  - nd_read_green converts straight to the single plane the encoder wants

#include <cstdint>
#include <cstdio>
#include <string>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libswscale/swscale.h>
}

namespace {

struct Decoder {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwsContext* sws_rgb = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_index = -1;
    int width = 0;
    int height = 0;
    double fps = 0.0;
    int64_t frame_count = 0;
    int64_t next_index = 0;  // index the next decode_next() call will yield
    bool eof_sent = false;
    bool saw_pts = false;  // stream has yielded a usable timestamp at least once
    AVRational tb{};
    int64_t start_ts = 0;
    // False when the container left start_time unset: the epoch is then
    // latched from the FIRST decoded frame's pts (decode_next). Without the
    // latch, streams whose packets carry a large pts base would map every
    // frame to a huge index — seeks would land at the file start and return
    // frames silently mislabeled as the requested indices.
    bool start_ts_known = false;
};

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

int64_t pts_to_index(const Decoder* d, int64_t pts) {
    if (pts == AV_NOPTS_VALUE) return -1;
    const double seconds = (pts - d->start_ts) * av_q2d(d->tb);
    return static_cast<int64_t>(seconds * d->fps + 0.5);
}

int64_t index_to_ts(const Decoder* d, int64_t index) {
    const double seconds = index / d->fps;
    return d->start_ts + static_cast<int64_t>(seconds / av_q2d(d->tb) + 0.5);
}

// Decode one frame in stream order into d->frame and update d->next_index.
// Returns 1 on success, 0 on EOF, <0 on error.
int decode_next(Decoder* d) {
    while (true) {
        int ret = avcodec_receive_frame(d->codec, d->frame);
        if (ret == 0) {
            const int64_t pts = d->frame->best_effort_timestamp;
            if (pts != AV_NOPTS_VALUE && !d->start_ts_known) {
                d->start_ts = pts;  // first presented frame defines index 0
                d->start_ts_known = true;
            }
            int64_t idx = pts_to_index(d, pts);
            if (idx < 0) idx = d->next_index;
            else d->saw_pts = true;
            d->next_index = idx + 1;
            return 1;
        }
        if (ret == AVERROR_EOF) return 0;
        if (ret != AVERROR(EAGAIN)) return ret;

        if (d->eof_sent) return 0;
        ret = av_read_frame(d->fmt, d->pkt);
        if (ret == AVERROR_EOF) {
            avcodec_send_packet(d->codec, nullptr);
            d->eof_sent = true;
            continue;
        }
        if (ret < 0) return ret;
        if (d->pkt->stream_index == d->stream_index) {
            ret = avcodec_send_packet(d->codec, d->pkt);
            av_packet_unref(d->pkt);
            if (ret < 0 && ret != AVERROR(EAGAIN)) return ret;
        } else {
            av_packet_unref(d->pkt);
        }
    }
}

int seek_before(Decoder* d, int64_t index) {
    // Without usable timestamps (e.g. raw elementary streams) the landing
    // index of a mid-stream seek is unknowable and counting from the
    // keyframe would silently return the wrong frames. Rewind to the true
    // stream start instead: counting from index 0 there is exact, and the
    // decode-and-discard forward walk stays correct (just slower).
    const bool trust_pts = d->saw_pts;
    int64_t target = trust_pts ? index_to_ts(d, index) : d->start_ts;
    int ret = av_seek_frame(d->fmt, d->stream_index, target,
                            AVSEEK_FLAG_BACKWARD);
    if (ret < 0 && trust_pts) {
        ret = av_seek_frame(d->fmt, d->stream_index, d->start_ts,
                            AVSEEK_FLAG_BACKWARD);
    }
    if (ret < 0) return ret;
    avcodec_flush_buffers(d->codec);
    d->eof_sent = false;
    d->next_index = 0;  // exact at stream start; corrected by PTS otherwise
    return 0;
}

// Convert the current frame to RGB24 at the OPEN dimensions. The swscale
// context is re-resolved per frame (sws_getCachedContext: a no-op when the
// geometry is unchanged) because some sources switch resolution or pixel
// format mid-stream — scaling such a frame with the open-time context would
// read past the decoded planes (srcSliceH larger than the actual frame).
// Returns 0 on success, <0 when no context can be built for the frame.
int copy_rgb(Decoder* d, uint8_t* dst) {
    d->sws_rgb = sws_getCachedContext(
        d->sws_rgb, d->frame->width, d->frame->height,
        static_cast<AVPixelFormat>(d->frame->format), d->width, d->height,
        AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!d->sws_rgb) return -1;
    uint8_t* planes[4] = {dst, nullptr, nullptr, nullptr};
    int strides[4] = {3 * d->width, 0, 0, 0};
    sws_scale(d->sws_rgb, d->frame->data, d->frame->linesize, 0,
              d->frame->height, planes, strides);
    return 0;
}

// Write only the green plane of the current frame to `dst` (h*w bytes),
// via the same RGB24 conversion as nd_read_rgb so the G values are
// bit-identical to RGB channel 1 (the reference consumed decord's RGB24;
// swscale's planar-GBRP path rounds differently, so it is NOT used here).
int copy_green(Decoder* d, uint8_t* dst, uint8_t* scratch_rgb) {
    if (copy_rgb(d, scratch_rgb) < 0) return -1;
    const size_t frame_px = static_cast<size_t>(d->width) * d->height;
    const uint8_t* src = scratch_rgb + 1;  // G of pixel 0
    for (size_t p = 0; p < frame_px; ++p) dst[p] = src[p * 3];
    return 0;
}

// Shared reposition rule for the read entry points. Returns 0 when the
// forward decode walk may proceed, <0 on a hard error. A failed seek with a
// forward target is NOT an error: decode-and-discard from the current
// position returns the exact frames (just slower) — precisely the case for
// PTS-less containers that reject timestamp seeks.
int reposition(Decoder* d, int64_t start) {
    if (start == d->next_index) return 0;
    const int64_t discard_limit =
        d->next_index + static_cast<int64_t>(2.0 * d->fps) + 64;
    if (start >= d->next_index && start <= discard_limit) return 0;
    int ret = seek_before(d, start);
    if (ret < 0 && start >= d->next_index) return 0;
    return ret;
}

// Shared body of nd_read_rgb / nd_read_green: reposition, then decode
// forward, discarding pre-target frames. `scratch_rgb` selects green mode
// (nullptr = RGB). Returns frames written, or <0 when nothing could be
// decoded at all — mid-stream corruption returns the frames decoded so far
// (a truncated recording still yields embeddings up to the bad frame).
int64_t read_frames(Decoder* d, int64_t start, int64_t count, uint8_t* out,
                    uint8_t* scratch_rgb) {
    if (reposition(d, start) < 0) return -1;
    const size_t frame_bytes = static_cast<size_t>(d->width) * d->height *
                               (scratch_rgb ? 1 : 3);
    int64_t written = 0;
    while (written < count) {
        int got = decode_next(d);
        if (got < 0) return written > 0 ? written : got;
        if (got == 0) break;
        const int64_t idx = d->next_index - 1;  // index of the decoded frame
        if (idx < start + written) continue;    // pre-target: discard
        // For CFR content idx == start + written; PTS gaps just advance.
        uint8_t* dst = out + written * frame_bytes;
        const int rc =
            scratch_rgb ? copy_green(d, dst, scratch_rgb) : copy_rgb(d, dst);
        if (rc < 0) return written > 0 ? written : -1;
        ++written;
    }
    return written;
}

}  // namespace

extern "C" {

void nd_close(Decoder* d);

Decoder* nd_open(const char* path, char* err, int errlen) {
    auto* d = new Decoder();
    if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0) {
        set_err(err, errlen, "could not open input");
        delete d;
        return nullptr;
    }
    if (avformat_find_stream_info(d->fmt, nullptr) < 0) {
        set_err(err, errlen, "could not read stream info");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    const AVCodec* dec = nullptr;
    d->stream_index =
        av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, &dec, 0);
    if (d->stream_index < 0 || !dec) {
        set_err(err, errlen, "no video stream");
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    AVStream* st = d->fmt->streams[d->stream_index];
    d->codec = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(d->codec, st->codecpar);
    d->codec->thread_count = 0;
    d->codec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    if (avcodec_open2(d->codec, dec, nullptr) < 0) {
        set_err(err, errlen, "could not open codec");
        nd_close(d);
        return nullptr;
    }
    d->width = d->codec->width;
    d->height = d->codec->height;
    d->tb = st->time_base;
    AVRational fr = av_guess_frame_rate(d->fmt, st, nullptr);
    d->fps = (fr.num && fr.den) ? av_q2d(fr) : 30.0;
    d->start_ts_known = st->start_time != AV_NOPTS_VALUE;
    d->start_ts = d->start_ts_known ? st->start_time : 0;
    d->frame_count = st->nb_frames;
    if (d->frame_count <= 0 && st->duration != AV_NOPTS_VALUE) {
        d->frame_count =
            static_cast<int64_t>(st->duration * av_q2d(d->tb) * d->fps + 0.5);
    }
    if (d->frame_count <= 0 && d->fmt->duration != AV_NOPTS_VALUE) {
        d->frame_count = static_cast<int64_t>(
            (d->fmt->duration / (double)AV_TIME_BASE) * d->fps + 0.5);
    }
    d->pkt = av_packet_alloc();
    d->frame = av_frame_alloc();
    d->sws_rgb = sws_getContext(d->width, d->height, d->codec->pix_fmt,
                                d->width, d->height, AV_PIX_FMT_RGB24,
                                SWS_BILINEAR, nullptr, nullptr, nullptr);
    if (!d->sws_rgb) {
        set_err(err, errlen, "could not create swscale context");
        nd_close(d);
        return nullptr;
    }
    return d;
}

void nd_close(Decoder* d) {
    if (!d) return;
    if (d->sws_rgb) sws_freeContext(d->sws_rgb);
    if (d->frame) av_frame_free(&d->frame);
    if (d->pkt) av_packet_free(&d->pkt);
    if (d->codec) avcodec_free_context(&d->codec);
    if (d->fmt) avformat_close_input(&d->fmt);
    delete d;
}

int nd_width(Decoder* d) { return d->width; }
int nd_height(Decoder* d) { return d->height; }
double nd_fps(Decoder* d) { return d->fps; }
int64_t nd_frame_count(Decoder* d) { return d->frame_count; }

// Decode `count` frames starting at `start` into `out` (count*h*w*3 bytes,
// RGB24). Returns frames decoded, or <0 on error.
int64_t nd_read_rgb(Decoder* d, int64_t start, int64_t count, uint8_t* out) {
    return read_frames(d, start, count, out, nullptr);
}

// Same but only the green plane (out: count*h*w bytes). `scratch_rgb` must
// hold one RGB frame (h*w*3 bytes; reused as the discard plane for B/R).
int64_t nd_read_green(Decoder* d, int64_t start, int64_t count, uint8_t* out,
                      uint8_t* scratch_rgb) {
    return read_frames(d, start, count, out, scratch_rgb);
}

}  // extern "C"
