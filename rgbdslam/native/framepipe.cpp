// framepipe: native RGB-D frame loading pipeline.
//
// Native runtime counterpart of the reference's dataset IO + thread
// runtime: the reference decodes images synchronously on the tracking thread
// (RGBDcamera::createFrame -> cv::imread x2, Core/RGBDcamera.cpp:89-97) and
// runs its backend/viewer on polling threads (SURVEY.md §1). Here the host
// pipeline is a C++ worker pool that prefetches and decodes PNG pairs
// (libpng) into pinned-style host buffers ahead of the device, handing frames
// to Python in submission order through a bounded ring — so image decode
// overlaps device compute instead of serializing with it.
//
// C ABI (ctypes):
//   void* fp_create(int n_workers, int capacity, int width, int height);
//   int   fp_submit(void* h, const char* rgb_path, const char* depth_path,
//                   double depth_factor, long user_tag);
//   int   fp_next(void* h, float* gray_out, float* depth_out, long* tag_out);
//   void  fp_close(void* h);     // no more submissions; drain allowed
//   void  fp_destroy(void* h);
//   int   fp_decode_png_gray(const char* path, float* out, int w, int h,
//                            double scale);  // synchronous single decode
//
// All decoded frames are float32: gray in [0,255] (8-bit RGB converted by
// BT.601 luma, matching cv::cvtColor BGR2GRAY used in Core/Frame.cpp:47),
// depth in meters (16-bit PNG / depth_factor, Core/Frame.cpp:48).

#include <png.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
    std::vector<float> gray;
    std::vector<float> depth;
    long tag = 0;
    bool ok = false;
};

struct Job {
    std::string rgb_path;
    std::string depth_path;
    double depth_factor;
    long tag;
    uint64_t seq;
};

// ---------------------------------------------------------------------------
// PNG decoding (libpng).  Handles 8-bit gray/RGB/RGBA (-> gray luma) and
// 16-bit gray (-> float * scale).
// ---------------------------------------------------------------------------

bool decode_png(const char* path, int want_w, int want_h, bool as_depth,
                double scale, float* out) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return false;

    png_byte header[8];
    if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
        std::fclose(fp);
        return false;
    }
    png_structp png =
        png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
    if (!png) {
        std::fclose(fp);
        return false;
    }
    png_infop info = png_create_info_struct(png);
    if (!info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return false;
    }
    png_init_io(png, fp);
    png_set_sig_bytes(png, 8);
    png_read_info(png, info);

    const int w = png_get_image_width(png, info);
    const int h = png_get_image_height(png, info);
    const int color = png_get_color_type(png, info);
    const int depth_bits = png_get_bit_depth(png, info);
    if (w != want_w || h != want_h) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return false;
    }
    // Reject Adam7-interlaced images: the single-pass row loop below would
    // silently decode progressive-pass garbage (dataset PNGs — TUM/ICL/CORBS
    // — are never interlaced; an honest failure beats corrupt frames).
    if (png_get_interlace_type(png, info) != PNG_INTERLACE_NONE) {
        png_destroy_read_struct(&png, &info, nullptr);
        std::fclose(fp);
        return false;
    }

    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (depth_bits < 8) png_set_expand_gray_1_2_4_to_8(png);
    png_read_update_info(png, info);

    const size_t rowbytes = png_get_rowbytes(png, info);
    std::vector<png_byte> row(rowbytes);
    const int channels = png_get_channels(png, info);
    const int bits = png_get_bit_depth(png, info);

    for (int y = 0; y < h; ++y) {
        png_read_row(png, row.data(), nullptr);
        float* dst = out + static_cast<size_t>(y) * w;
        if (as_depth) {
            if (bits == 16 && channels == 1) {
                // PNG is big-endian
                for (int x = 0; x < w; ++x) {
                    const uint16_t v =
                        (uint16_t(row[2 * x]) << 8) | uint16_t(row[2 * x + 1]);
                    dst[x] = static_cast<float>(v * scale);
                }
            } else if (bits == 8 && channels == 1) {
                for (int x = 0; x < w; ++x)
                    dst[x] = static_cast<float>(row[x] * scale);
            } else {
                png_destroy_read_struct(&png, &info, nullptr);
                std::fclose(fp);
                return false;
            }
        } else {
            if (bits == 8 && channels >= 3) {
                for (int x = 0; x < w; ++x) {
                    const float r = row[channels * x + 0];
                    const float g = row[channels * x + 1];
                    const float b = row[channels * x + 2];
                    dst[x] = 0.299f * r + 0.587f * g + 0.114f * b;
                }
            } else if (bits == 8 && channels == 1) {
                for (int x = 0; x < w; ++x) dst[x] = row[x];
            } else if (bits == 16 && channels == 1) {
                for (int x = 0; x < w; ++x) {
                    const uint16_t v =
                        (uint16_t(row[2 * x]) << 8) | uint16_t(row[2 * x + 1]);
                    dst[x] = v / 257.0f;
                }
            } else {
                png_destroy_read_struct(&png, &info, nullptr);
                std::fclose(fp);
                return false;
            }
        }
    }
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return true;
}

// ---------------------------------------------------------------------------
// Pipeline: bounded job queue -> worker pool -> ordered result map.
// ---------------------------------------------------------------------------

class FramePipe {
  public:
    FramePipe(int n_workers, int capacity, int width, int height)
        : capacity_(capacity), width_(width), height_(height) {
        for (int i = 0; i < n_workers; ++i)
            workers_.emplace_back([this] { worker(); });
    }

    ~FramePipe() {
        {
            std::unique_lock<std::mutex> lk(mu_);
            closed_ = true;
            stop_ = true;
        }
        cv_jobs_.notify_all();
        cv_results_.notify_all();
        cv_space_.notify_all();
        for (auto& t : workers_) t.join();
    }

    int submit(const char* rgb, const char* depth, double factor, long tag) {
        std::unique_lock<std::mutex> lk(mu_);
        if (closed_) return -1;
        cv_space_.wait(lk, [this] {
            return stop_ || static_cast<int>(jobs_.size() + in_flight_ +
                                             results_.size()) < capacity_;
        });
        if (stop_) return -1;
        Job j;
        j.rgb_path = rgb;
        j.depth_path = depth;
        j.depth_factor = factor;
        j.tag = tag;
        j.seq = next_seq_++;
        jobs_.push_back(std::move(j));
        cv_jobs_.notify_one();
        return 0;
    }

    // Blocks for the next frame in submission order. Returns 1 on success,
    // 0 when drained+closed, -1 on decode failure for that frame.
    int next(float* gray_out, float* depth_out, long* tag_out) {
        std::unique_lock<std::mutex> lk(mu_);
        const uint64_t want = next_deliver_;
        cv_results_.wait(lk, [&] {
            return stop_ || results_.count(want) ||
                   (closed_ && jobs_.empty() && in_flight_ == 0 &&
                    !results_.count(want));
        });
        auto it = results_.find(want);
        if (it == results_.end()) return 0;  // drained
        std::unique_ptr<Frame> f = std::move(it->second);
        results_.erase(it);
        next_deliver_++;
        cv_space_.notify_all();
        lk.unlock();

        if (!f->ok) return -1;
        std::memcpy(gray_out, f->gray.data(), f->gray.size() * sizeof(float));
        std::memcpy(depth_out, f->depth.data(), f->depth.size() * sizeof(float));
        *tag_out = f->tag;
        return 1;
    }

    void close() {
        std::unique_lock<std::mutex> lk(mu_);
        closed_ = true;
        cv_jobs_.notify_all();
        cv_results_.notify_all();
    }

  private:
    void worker() {
        for (;;) {
            Job job;
            {
                std::unique_lock<std::mutex> lk(mu_);
                cv_jobs_.wait(lk, [this] { return stop_ || !jobs_.empty() ||
                                                  (closed_ && jobs_.empty()); });
                if (stop_ || (closed_ && jobs_.empty())) return;
                job = std::move(jobs_.front());
                jobs_.pop_front();
                in_flight_++;
            }
            auto f = std::make_unique<Frame>();
            const size_t n = static_cast<size_t>(width_) * height_;
            f->gray.resize(n);
            f->depth.resize(n);
            f->tag = job.tag;
            const bool ok_rgb = decode_png(job.rgb_path.c_str(), width_, height_,
                                           /*as_depth=*/false, 1.0,
                                           f->gray.data());
            const bool ok_d = decode_png(job.depth_path.c_str(), width_, height_,
                                         /*as_depth=*/true,
                                         1.0 / job.depth_factor, f->depth.data());
            f->ok = ok_rgb && ok_d;
            {
                std::unique_lock<std::mutex> lk(mu_);
                results_[job.seq] = std::move(f);
                in_flight_--;
            }
            cv_results_.notify_all();
        }
    }

    const int capacity_;
    const int width_, height_;
    std::mutex mu_;
    std::condition_variable cv_jobs_, cv_results_, cv_space_;
    std::deque<Job> jobs_;
    std::map<uint64_t, std::unique_ptr<Frame>> results_;
    std::vector<std::thread> workers_;
    uint64_t next_seq_ = 0;
    uint64_t next_deliver_ = 0;
    int in_flight_ = 0;
    bool closed_ = false;
    bool stop_ = false;
};

}  // namespace

extern "C" {

void* fp_create(int n_workers, int capacity, int width, int height) {
    return new FramePipe(n_workers, capacity, width, height);
}

int fp_submit(void* h, const char* rgb, const char* depth, double factor,
              long tag) {
    return static_cast<FramePipe*>(h)->submit(rgb, depth, factor, tag);
}

int fp_next(void* h, float* gray_out, float* depth_out, long* tag_out) {
    return static_cast<FramePipe*>(h)->next(gray_out, depth_out, tag_out);
}

void fp_close(void* h) { static_cast<FramePipe*>(h)->close(); }

void fp_destroy(void* h) { delete static_cast<FramePipe*>(h); }

int fp_decode_png_gray(const char* path, float* out, int w, int h,
                       double scale) {
    return decode_png(path, w, h, scale != 1.0, scale, out) ? 1 : 0;
}

}  // extern "C"
